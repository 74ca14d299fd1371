"""Native (C++) host post-processing of the port, built with g++ at first use."""
