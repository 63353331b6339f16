"""Models of the plain reference."""
