"""Step functions of the port (serving)."""
