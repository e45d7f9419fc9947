"""Command-line entry points of the port, and the fleet meshes
(``mesh.py``) and logical-axis layout rules (``sharding.py``) of the fleet
engines."""
