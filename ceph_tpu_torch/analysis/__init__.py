"""The port's analysis tools: so far the race sanitizer's access tracker
(``racecheck``), which the OSD's probes read."""
