"""Models of the port: the device snapshot and the scanner."""
