"""Serving step functions and the serve CLI."""
