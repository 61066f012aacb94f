"""BLAST parameterization (``blast``) and the structured-linear interface
(``structures``) of the port."""
