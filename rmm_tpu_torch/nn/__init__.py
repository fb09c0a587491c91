"""Neural-network modules of the port."""
