"""The program's entry points the window drives, a module each, found by
the name a workload file gives."""
