"""Helpers of the port with no counterpart module in the JAX package."""
