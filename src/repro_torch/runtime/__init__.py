"""Serving runtime: device selection and the DSA-planned KV accounting."""
