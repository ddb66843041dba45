"""Configuration dataclasses (port of ``repro.configs``)."""
