"""DDAL (paper §5): knowledge stores, eq. 4 weighting, delay lines,
topologies and the exchange protocol (port of ``repro.core``)."""
