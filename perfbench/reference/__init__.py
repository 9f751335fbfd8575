"""Plain references of the configurations, one file each, and what they share."""
