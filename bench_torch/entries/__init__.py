"""Timed entries, one module each, named by a traffic mix's ``entry``."""
