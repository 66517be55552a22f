"""Launchers: the serving, training, load and paper entry points, the
decode profile, and the dry run with its aten analysis and roofline."""
