"""Launch tooling of the port: the training driver (``train``)."""
