"""Framework core of the port: coded errors and the flags it reads."""
