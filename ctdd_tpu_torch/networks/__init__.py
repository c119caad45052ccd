"""Score networks of the port."""
