import sys

from searchbench.run import main

sys.exit(main())
