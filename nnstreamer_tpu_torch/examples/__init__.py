"""Runnable examples of the port: custom filters (``custom_filters/``)."""
