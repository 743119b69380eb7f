"""Recipe command lines of the port (run with `python -m`)."""
