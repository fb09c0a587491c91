"""Task wrappers and the serving trainer."""
