"""Compiler, planner, formats and engines of the port."""
