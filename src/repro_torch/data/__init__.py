"""data of the port."""
