"""A reference package for the tests: the frozen reference
(``gpubench/reference``) re-exported, but for one pair's score, which its
``driver`` changes.  A configuration that names it has that pair judged
wrong, which shows that the package a configuration names is the one that
judges."""
