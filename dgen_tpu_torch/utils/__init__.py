"""Run-time checks of the port."""
