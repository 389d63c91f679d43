"""Real-robot serving of the port (launcher for the HTTP server)."""
