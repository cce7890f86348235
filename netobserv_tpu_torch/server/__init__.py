"""The port's debug HTTP server (`server/debug.py`)."""
