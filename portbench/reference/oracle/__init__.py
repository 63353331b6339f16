"""History decoder, specs and WGL checker of the plain reference."""
