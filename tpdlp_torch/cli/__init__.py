"""Command-line front end of tpdlp_torch (counterpart of tpdlp/cli)."""
