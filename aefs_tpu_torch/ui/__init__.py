"""The control-plane UI's HTTP server (``app.py``)."""
