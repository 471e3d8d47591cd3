"""The harness: scene, cameras, the port's objects, the drivers, the trace."""
