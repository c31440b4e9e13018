"""The port's tracker and local launcher (``tracker.py``, ``launch.py``)."""
