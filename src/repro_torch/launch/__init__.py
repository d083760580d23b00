"""Launch tooling of the port: the training launcher (``train``), the
H100's roofline terms (``roofline``) and trip-count-corrected HLO text
costs (``hlo_analysis``)."""
