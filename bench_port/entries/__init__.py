"""Entries the window drives: one module per public entry of the port,
named by a configuration's `entry` key."""
