"""Slotted simulator (port of ``repro/sim``)."""
