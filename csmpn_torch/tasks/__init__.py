"""Task entry points of the port."""
