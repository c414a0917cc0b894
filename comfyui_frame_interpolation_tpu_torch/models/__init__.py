"""Ported model families: RIFE (arch 4.7, 4.17, 4.26), M2M and FILM so far."""
