"""Config, seeding, batches, checkpoints and device selection."""
