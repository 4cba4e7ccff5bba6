"""Elastic eviction and readmission over the node axis (``reassignment``)."""
