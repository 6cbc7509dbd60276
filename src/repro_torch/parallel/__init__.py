"""Sharding rules (``sharding``) and the per-rank collectives of the GSPMD
trainer's programs (``spmd``)."""
