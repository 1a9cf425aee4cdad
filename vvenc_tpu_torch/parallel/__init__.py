"""Device mesh of the port: parallel.mesh."""
