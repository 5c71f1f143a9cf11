"""LM serving of the port."""
