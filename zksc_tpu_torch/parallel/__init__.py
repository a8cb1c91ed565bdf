"""The multi-device layer: the mesh of shards (mesh.py) and the
multi-process orchestration (multihost.py)."""
