"""Ported model families: RIFE (every arch of the JAX package), M2M, FILM,
GMFSS Fortuna (base and union), EISAI, STMFNet and FLAVR so far."""
