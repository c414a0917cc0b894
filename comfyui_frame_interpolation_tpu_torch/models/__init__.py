"""Ported model families: RIFE (arch 4.6, 4.7, 4.17, 4.26), M2M, FILM and
GMFSS Fortuna (base and union) so far."""
