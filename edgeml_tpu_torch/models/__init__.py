"""Detector models and the serving loop."""
