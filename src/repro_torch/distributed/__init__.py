"""Multi-device placement of the port (``distributed.sharding``)."""
