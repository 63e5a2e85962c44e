"""Drivers, one a traffic kind, found by the ``kind`` of a cell's file."""
