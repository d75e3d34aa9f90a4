"""Serving: the multi-session pool server (``pool.py``)."""
