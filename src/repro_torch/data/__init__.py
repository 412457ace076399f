"""Calibration and synthetic token data of the port."""
