"""Graph data of the port."""
