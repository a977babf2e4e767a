"""I/O subsystem: self-contained FITS reading/writing and celestial WCS
(numpy only; the port's own copies of the JAX package's modules)."""
