"""The distributed runtime's launch layer: named-axis meshes and their
collectives (``mesh.py``), the sharding rules (``sharding.py``) and the
pipeline-stage boundary (``pipeline.py``)."""
