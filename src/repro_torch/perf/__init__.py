"""Dry-run cost model of the port: the three roofline terms
(``roofline``), the op counter that feeds them (``op_cost``), the per-rank
analysis of a step (``step_analysis``) and a cell's top contributors
(``diagnose``)."""
