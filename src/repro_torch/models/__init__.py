"""models of the port."""
