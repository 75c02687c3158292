"""Whole-frame codec on one device."""
