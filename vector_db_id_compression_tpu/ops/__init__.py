"""Pallas GPU kernels for the hot codec paths, and the route that picks
them per backend."""
