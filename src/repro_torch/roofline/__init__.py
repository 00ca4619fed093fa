"""Roofline accounting of the port's programs: a trace of the aten ops a
program dispatches (``trace_analysis``), the H100 roofline terms of that
trace (``report``) and the tables of the dry run's records (``tables``)."""
