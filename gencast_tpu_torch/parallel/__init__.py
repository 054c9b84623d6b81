"""Multi-member (ensemble) execution for the port."""
