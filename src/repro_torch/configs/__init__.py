"""configs of the port."""
