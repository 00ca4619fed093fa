"""Topology events (ADD and DEL arcs) of every micro-batch handed in, over
the window's wall time, queries and everything else included."""


def read(run):
    return run.events / run.window_s if run.window_s > 0 else None
