"""Schedule, dataflow dispatch and the plain reference dataflows."""
