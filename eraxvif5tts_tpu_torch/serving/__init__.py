"""Serving layer of the port: the raw-TCP streaming socket server."""
