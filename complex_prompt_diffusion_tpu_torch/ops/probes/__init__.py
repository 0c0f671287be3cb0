"""Opt-in kernel probes: ported and tested, dispatched by no layer."""
