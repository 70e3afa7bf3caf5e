from bauklank.cli import main

raise SystemExit(main())
