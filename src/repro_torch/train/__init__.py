"""Local solver pieces of the port (SGD with momentum, clipping) and the
LM zoo's step builders (``trainstep``)."""
