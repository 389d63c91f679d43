"""Image encoders used by the port."""
