"""Input generation of the port."""
