"""The paper-reproduction benchmarks (Figs. 2–5) on the torch path:
twins of ``benchmarks/paper_fig*.py``, run as
``python -m repro_torch.benchmarks.paper_fig2_a2c``."""
