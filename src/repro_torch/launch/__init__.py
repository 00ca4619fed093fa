"""Device meshes for the sharded engine (``launch/mesh.py``)."""
