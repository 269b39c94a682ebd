"""The GSPMD sharding rules (``parallel.sharding``) -- the port of
``repro/parallel``."""
