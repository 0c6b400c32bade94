"""Runnable entries of the port (``lm_demo``: LM training)."""
