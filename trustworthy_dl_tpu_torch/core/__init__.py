"""Configuration of the port's serving engine."""
