"""Step counts and the one-card roofline: ``flops.py``, ``roofline.py``."""
