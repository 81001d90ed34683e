"""One module a kind of traffic (``traffic/<name>.json``'s ``kind``): it
builds the system, warms it up, runs the window and the check."""
