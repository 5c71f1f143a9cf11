"""Data of the port: graphs, samplers and the token pipeline."""
