"""Runnable examples of the port: custom filters (``custom_filters/``) and
streaming training (``train_stream.py``)."""
