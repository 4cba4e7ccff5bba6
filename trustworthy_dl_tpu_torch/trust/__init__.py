"""Trust state (``state``) and its host reporting view (``manager``)."""
