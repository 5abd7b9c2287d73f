"""The fleet serving path: ticketing, device apply, device scribe."""
