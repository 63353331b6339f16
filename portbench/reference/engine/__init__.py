"""Engine of the plain reference."""
