"""Network-namespace entry for the self-managed fetchers' attach."""
