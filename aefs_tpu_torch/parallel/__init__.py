"""Scaling over streams: the (data, model) device mesh (``mesh.py``)."""
