"""Host-side packers of the flow feeds."""
