"""Local solver pieces of the port (SGD with momentum, clipping)."""
