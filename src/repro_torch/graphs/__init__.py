"""Host-side (numpy) graph builders and stream generators the port uses,
copied from ``repro.graphs``."""
