"""Decoder subplugins (tensor → media post-processing)."""
