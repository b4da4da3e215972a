"""Train step and loop of the port."""
