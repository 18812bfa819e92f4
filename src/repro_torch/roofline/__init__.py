"""Cost counting and the roofline of the port — the twin of
``repro/roofline``."""
