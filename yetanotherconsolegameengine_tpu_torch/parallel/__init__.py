"""Multi-device row sharding of the frame step (``sharding.py``)."""
