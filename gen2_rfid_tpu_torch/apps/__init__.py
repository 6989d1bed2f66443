"""Command-line applications of the port: the offline reader CLI and the capture plot."""
