"""DDS pieces the serving stage shares with clients."""
