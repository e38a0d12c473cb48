"""Operators of the port: physics, worldline ring, renderer and kernel wrappers."""
