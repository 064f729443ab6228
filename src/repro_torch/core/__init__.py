"""TORTA core (port of ``repro/core``): OT macro layer with the EMA
forecast, and the fused micro greedy."""
