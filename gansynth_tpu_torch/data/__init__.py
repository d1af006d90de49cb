"""Data for the port: synthetic fixture notes."""
