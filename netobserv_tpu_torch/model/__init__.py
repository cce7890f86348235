"""Package marker."""
