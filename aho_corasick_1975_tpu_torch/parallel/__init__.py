"""Multi-device sharding of the port (mesh.py, sharded_scan.py)."""
